"""K8s validating-admission webhook (copied from
``trivy_tpu/watch/admission.py``; docs/serving.md "Continuous
scanning & admission control").

``POST /k8s/admission`` takes an ``AdmissionReview`` (v1), extracts
every pod image reference from the reviewed object (any workload
kind the k8s scanner understands), resolves a scan verdict for each
within the request's deadline — the apiserver's ``?timeout=10s``
query parameter, or the configured default — and answers
allow/deny + audit annotations from the severity policy.

Latency model: the verdict cache (keyed by the findings-memo
``ctx_sig`` x image digest x policy) makes the repeat case free; a
cache miss scans through the shared scheduler, where warm memo
entries (docs/performance.md §7) make the common case a sub-second
cache hit. A miss that cannot resolve inside the deadline applies
the configured fail stance — ``open`` (allow + annotate), ``closed``
(deny), or ``408`` (surface the deadline as HTTP 408 and let the
webhook's own ``failurePolicy`` decide) — and enqueues a background
scan so the NEXT admission of that digest hits.

Invalidation: because every cached verdict is keyed by the memo
``ctx_sig`` (advisory-DB content fingerprint x rule-set x guard
config x scanner version), a ``db update`` hot swap strands the old
generation's verdicts exactly like findings entries — the next
review keys against the new context and recomputes. A swap hook on
the ``SwappableStore`` additionally drops the stranded entries so
the cache never holds unreachable generations.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..memo import keys as MK
from ..sched import DeadlineExceeded
from ..types.common import SEVERITIES
from .metrics import WATCH_METRICS

log = logging.getLogger("trivy_tpu_torch.watch.admission")

SEVERITY_NAMES = tuple(str(s) for s in SEVERITIES)
ADMISSION_TENANT = "k8s-admission"
# background re-scans ride a LOW priority class: they must never
# jump a live admission's line within the tenant
BACKGROUND_PRIORITY = -50
ADMISSION_PRIORITY = 50
VERDICT_CACHE_CAP = 4096


class MalformedReview(ValueError):
    """Not an AdmissionReview we can answer (HTTP 400)."""


class AdmissionUnavailable(RuntimeError):
    """Deadline/degraded with the ``408`` fail stance: surfaced as
    HTTP 408 so the webhook's K8s-side ``failurePolicy`` decides."""


@dataclass(frozen=True)
class AdmissionPolicy:
    """``--admission-policy`` grammar: ``deny:SEV[,SEV...]`` (deny
    when any finding at one of these severities is present) or
    ``audit`` (never deny; annotations only). ``fail`` is the
    degraded/deadline stance: open | closed | 408."""

    deny: tuple = ("CRITICAL",)
    fail: str = "open"

    @classmethod
    def parse(cls, text: str = "",
              fail: str = "open") -> "AdmissionPolicy":
        text = (text or "").strip() or "deny:CRITICAL"
        if fail not in ("open", "closed", "408"):
            raise ValueError(
                f"bad admission fail stance {fail!r} "
                "(want open, closed or 408)")
        if text == "audit":
            return cls(deny=(), fail=fail)
        kind, sep, rest = text.partition(":")
        if kind != "deny" or not sep:
            raise ValueError(
                f"bad admission policy {text!r} (want "
                "'deny:SEV[,SEV...]' or 'audit')")
        sevs = tuple(s.strip().upper() for s in rest.split(",")
                     if s.strip())
        bad = [s for s in sevs if s not in SEVERITY_NAMES]
        if bad or not sevs:
            raise ValueError(
                f"bad admission severities {bad or rest!r} "
                f"(choose from {', '.join(SEVERITY_NAMES)})")
        return cls(deny=sevs, fail=fail)

    def sig(self) -> str:
        return ",".join(self.deny) or "audit"


@dataclass
class Verdict:
    """One image's cached admission answer."""

    allowed: bool
    counts: dict = field(default_factory=dict)
    detail: str = ""
    trace_id: str = ""
    source: str = "scan"        # scan | cache | fail-open

    def annotation(self) -> str:
        sevs = ",".join(f"{s}:{n}" for s, n in
                        sorted(self.counts.items(),
                               key=lambda kv: kv[0]) if n)
        base = "allow" if self.allowed else "deny"
        return f"{base}({sevs})" if sevs else \
            (base if not self.detail else f"{base}:{self.detail}")


def severity_counts(report) -> dict:
    """Severity histogram over a Report: vulnerabilities, secret
    findings, and FAILed misconfigurations all count — the policy
    speaks severities, not finding classes."""
    counts: dict = {}

    def bump(sev: str) -> None:
        sev = sev if sev in SEVERITY_NAMES else "UNKNOWN"
        counts[sev] = counts.get(sev, 0) + 1

    for r in getattr(report, "results", None) or []:
        for v in getattr(r, "vulnerabilities", None) or []:
            bump(getattr(v, "severity", "UNKNOWN"))
        for s in getattr(r, "secrets", None) or []:
            bump(getattr(s, "severity", "UNKNOWN"))
        for m in getattr(r, "misconfigurations", None) or []:
            if getattr(m, "status", "") == "FAIL":
                bump(getattr(m, "severity", "UNKNOWN"))
    return counts


def images_from_review(review) -> tuple:
    """AdmissionReview → (uid, [image refs]). Raises
    :class:`MalformedReview` on anything that is not a v1
    AdmissionReview with a reviewable object."""
    if not isinstance(review, dict) or \
            review.get("kind") != "AdmissionReview":
        raise MalformedReview("body is not an AdmissionReview")
    request = review.get("request")
    if not isinstance(request, dict) or not request.get("uid"):
        raise MalformedReview("AdmissionReview carries no request")
    obj = request.get("object")
    if not isinstance(obj, dict):
        raise MalformedReview("AdmissionReview carries no object")
    from ..k8s import images_from_object
    return str(request["uid"]), images_from_object(obj)


class VerdictCache:
    """Bounded LRU of admission verdicts keyed by
    ``memo.keys.verdict_sig(ctx, image, policy)`` — the ctx
    component is what makes a ``db update`` hot swap strand the old
    generation (satellite: invalidation exactly like findings
    entries). ``drop_ctx`` removes stranded entries eagerly when the
    holder exposes a swap hook. ``get(max_age_s=...)`` lets the
    caller bound entry age: a digest-pinned ref is content-addressed
    and caches indefinitely, but a mutable TAG ref can be repushed
    with different content, so its verdict must expire."""

    def __init__(self, cap: int = VERDICT_CACHE_CAP):
        self.cap = max(16, cap)
        self._lock = threading.Lock()
        # key -> (ctx, Verdict, monotonic stamp)
        self._d: OrderedDict = OrderedDict()

    def get(self, key: str, max_age_s=None):
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                return None
            if max_age_s is not None and \
                    time.monotonic() - hit[2] > max_age_s:
                del self._d[key]       # expired: recompute
                return None
            self._d.move_to_end(key)
            return hit[1]

    def put(self, key: str, ctx: str, verdict) -> None:
        with self._lock:
            self._d[key] = (ctx, verdict, time.monotonic())
            self._d.move_to_end(key)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def drop_ctx(self, ctx: str) -> int:
        with self._lock:
            dead = [k for k, (c, _, _) in self._d.items()
                    if c == ctx]
            for k in dead:
                del self._d[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class AdmissionController:
    """One controller per server/watch process. ``runner`` provides
    ``submit_path`` (scans share the process scheduler); ``store``
    is the advisory holder the CONTEXT derives from — a
    ``SwappableStore`` keeps verdicts generation-correct across
    ``db update`` hot swaps (and gets a swap hook that drops the
    stranded generation's cache entries)."""

    def __init__(self, runner, store=None, memo=None, policy=None,
                 resolver=None, default_deadline_s: float = 10.0,
                 background_rescan: bool = True,
                 security_checks=None,
                 tag_verdict_ttl_s: float = 30.0):
        self.runner = runner
        # which finding classes feed the severity policy; vuln +
        # secret by default (misconfig checks need policy modules
        # the admission path does not configure)
        self.security_checks = list(security_checks
                                    or ("vuln", "secret"))
        # the cache key folds the check set in next to the policy:
        # a vuln-only verdict must never serve a vuln+secret review
        self._policy_sig = "|".join(
            ((policy or AdmissionPolicy()).sig() or "audit",
             ",".join(sorted(self.security_checks))))
        self.store = store if store is not None \
            else getattr(runner, "store", None)
        self.memo = memo
        self.policy = policy or AdmissionPolicy()
        self.resolver = resolver
        self.default_deadline_s = default_deadline_s
        self.background_rescan = background_rescan
        # verdicts for MUTABLE tag refs (no @digest pin) expire: the
        # tag can be repushed with different content and nothing
        # here observes the push — only a digest-pinned ref is
        # content-addressed enough to cache until the next db swap
        self.tag_verdict_ttl_s = tag_verdict_ttl_s
        self.cache = VerdictCache()
        self._bg: list = []            # (key, ctx, req) futures
        self._bg_reserved = 0          # slots claimed pre-submit
        self._bg_lock = threading.Lock()
        holder = self.store
        if holder is not None and \
                hasattr(holder, "add_swap_hook"):
            holder.add_swap_hook(self._on_swap)

    # --- context ---

    def _current_db(self):
        holder = self.store
        if holder is not None and hasattr(holder, "current"):
            return holder.current()
        return holder

    def _ctx(self, db=None) -> str:
        db = db if db is not None else self._current_db()
        if self.memo is not None:
            return self.memo.ctx_for(db)
        return MK.db_fingerprint(db)

    def _on_swap(self, old_db, new_db) -> None:
        dropped = self.cache.drop_ctx(self._ctx(old_db))
        if dropped:
            log.info("db hot swap stranded %d admission verdicts",
                     dropped)

    # --- verdicts ---

    def _verdict_from_result(self, result) -> Verdict:
        report = getattr(result, "report", None)
        if report is None or getattr(result, "error", ""):
            raise RuntimeError(getattr(result, "error", "")
                               or "scan produced no report")
        counts = severity_counts(report)
        denied = any(counts.get(s, 0) for s in self.policy.deny)
        return Verdict(allowed=not denied, counts=counts)

    def _harvest_background(self) -> None:
        """Completed background scans populate the verdict cache so
        the NEXT admission of that digest hits — polled at review
        time (no reaper thread to leak)."""
        with self._bg_lock:
            live = []
            for key, ctx, req in self._bg:
                if not req.done:
                    live.append((key, ctx, req))
                    continue
                try:
                    v = self._verdict_from_result(req.result(
                        timeout=0))
                    v.trace_id = getattr(req, "trace_id", "") or ""
                    self.cache.put(key, ctx, v)
                except Exception as e:   # noqa: BLE001 — a failed
                    # background scan just means the next admission
                    # scans again
                    log.warning("background admission scan "
                                "failed: %r", e)
            self._bg = live

    def _enqueue_background(self, key: str, ctx: str,
                            path: str) -> None:
        if not self.background_rescan:
            return
        # the 64-entry backlog bound is RESERVED before submitting
        # (concurrent reviews race here — ThreadingHTTPServer), so
        # an over-bound scan never burns device time just to be
        # discarded
        with self._bg_lock:
            if len(self._bg) + self._bg_reserved >= 64:
                return
            self._bg_reserved += 1
        req = None
        try:
            req = self.runner.submit_path(
                path, self._options(), tenant=ADMISSION_TENANT,
                priority=BACKGROUND_PRIORITY)
        # lint: disable=bare-except-at-seam -- best-effort warmer:
        # it fails under exactly the backpressure it must not log-
        # storm about; the review already answered from the stance
        except Exception:            # noqa: BLE001 — backpressure on
            pass                     # a best-effort warmer is fine
        finally:
            with self._bg_lock:
                self._bg_reserved -= 1
                if req is not None:
                    self._bg.append((key, ctx, req))
        if req is not None:
            WATCH_METRICS.inc("admission_background_scans")

    def _options(self, deadline_s: float = 0.0):
        from ..types import ScanOptions
        opts = ScanOptions(backend=getattr(self.runner, "backend",
                                           "cuda"),
                           security_checks=list(
                               self.security_checks))
        if deadline_s > 0:
            opts.deadline_s = deadline_s
        return opts

    def _image_verdict(self, ref: str, ctx: str,
                       deadline: float) -> Verdict:
        pinned = "@" in ref
        digest = ref.rpartition("@")[2] if pinned else ref
        key = MK.verdict_sig(ctx, digest, self._policy_sig)
        hit = self.cache.get(
            key, max_age_s=None if pinned
            else self.tag_verdict_ttl_s)
        if hit is not None:
            WATCH_METRICS.inc("admission_cache_hits")
            hit = Verdict(allowed=hit.allowed,
                          counts=dict(hit.counts),
                          detail=hit.detail,
                          trace_id=hit.trace_id, source="cache")
            return hit
        WATCH_METRICS.inc("admission_cache_misses")
        path = self.resolver(ref, digest) \
            if self.resolver is not None else None
        if path is None:
            raise DeadlineExceeded(
                f"image {ref!r} not resolvable to a scan target")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            WATCH_METRICS.inc("admission_timeout")
            self._enqueue_background(key, ctx, path)
            raise DeadlineExceeded(
                f"admission deadline exhausted before {ref!r}")
        req = self.runner.submit_path(
            path, self._options(deadline_s=remaining),
            tenant=ADMISSION_TENANT, priority=ADMISSION_PRIORITY)
        try:
            result = req.result()
        except DeadlineExceeded:
            WATCH_METRICS.inc("admission_timeout")
            self._enqueue_background(key, ctx, path)
            raise
        verdict = self._verdict_from_result(result)
        verdict.trace_id = getattr(req, "trace_id", "") or ""
        self.cache.put(key, ctx, verdict)
        return verdict

    # --- the review entry point (HTTP route + tests) ---

    def review(self, body: dict,
               deadline_s: float = 0.0) -> dict:
        """One AdmissionReview → the response AdmissionReview.
        Raises :class:`MalformedReview` (400) on garbage and
        :class:`AdmissionUnavailable` (408) only under the ``408``
        fail stance; every other degraded path answers a valid
        review per the configured stance."""
        t0 = time.monotonic()
        deadline = t0 + (deadline_s
                         if deadline_s and deadline_s > 0
                         else self.default_deadline_s)
        self._harvest_background()
        uid, images = images_from_review(body)
        ctx = self._ctx()
        WATCH_METRICS.inc("admission_reviews")
        verdicts: list = []            # (ref, Verdict|None, err)
        for ref in images:
            try:
                verdicts.append((ref,
                                 self._image_verdict(ref, ctx,
                                                     deadline),
                                 None))
            except Exception as e:   # noqa: BLE001 — deadline,
                # unresolvable, scan failure: the fail stance decides
                verdicts.append((ref, None, e))
        denied = [ref for ref, v, _ in verdicts
                  if v is not None and not v.allowed]
        failed = [(ref, err) for ref, v, err in verdicts
                  if v is None]
        fail = self.policy.fail
        if failed and fail == "408":
            # admission_timeout was already counted where the
            # deadline actually expired (_image_verdict) — counting
            # here too would double the total operators alert on
            raise AdmissionUnavailable(
                "; ".join(f"{ref}: {err}" for ref, err in failed))
        if failed and fail == "closed":
            denied.extend(ref for ref, _ in failed)
        if failed and fail == "open":
            WATCH_METRICS.inc("admission_fail_open", len(failed))
        allowed = not denied
        WATCH_METRICS.inc("admission_allow" if allowed
                          else "admission_deny")
        annotations = {}
        for i, (ref, v, err) in enumerate(verdicts):
            if v is not None:
                annotations[f"trivy-tpu/image-{i}"] = \
                    f"{ref}: {v.annotation()} [{v.source}]"
                if v.trace_id:
                    annotations[f"trivy-tpu/trace-{i}"] = v.trace_id
            else:
                stance = ("fail-open" if fail == "open"
                          else "fail-closed")
                annotations[f"trivy-tpu/image-{i}"] = \
                    f"{ref}: {stance} ({err})"
        annotations["trivy-tpu/policy"] = \
            f"deny:{self.policy.sig()}" if self.policy.deny \
            else "audit"
        exemplar = next((v.trace_id for _, v, _ in verdicts
                         if v is not None and v.trace_id), "")
        WATCH_METRICS.observe("admission_latency",
                              time.monotonic() - t0,
                              trace_id=exemplar)
        response = {"uid": uid, "allowed": allowed,
                    "auditAnnotations": annotations}
        if not allowed:
            reasons = denied[:4]
            response["status"] = {
                "code": 403,
                "reason": "AdmissionDenied",
                "message": "trivy-tpu admission policy "
                           f"deny:{self.policy.sig()} rejected: "
                           + ", ".join(reasons)}
        return {"apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "response": response}

    def stats(self) -> dict:
        with self._bg_lock:
            bg = len(self._bg)
        return {"cache_entries": len(self.cache),
                "background_pending": bg,
                "policy": (f"deny:{self.policy.sig()}"
                           if self.policy.deny else "audit"),
                "fail": self.policy.fail,
                "default_deadline_s": self.default_deadline_s}
