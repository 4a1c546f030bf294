"""Continuous-scanning subsystem (copied from ``trivy_tpu/watch/``;
docs/serving.md "Continuous scanning & admission control").

Two event-driven front-ends over one core loop:

* ``python -m trivy_tpu_torch watch`` — subscribe to registry push
  events (Docker Registry v2 notification webhooks, or a seeded
  synthetic source) and keep the fleet scanned: dedupe/debounce per image digest,
  bounded in-flight watermarks, checkpointed cursor, submissions
  through the shared continuous-batching scheduler with per-source
  tenant identity;
* ``POST /k8s/admission`` — a K8s ValidatingWebhookConfiguration-
  compatible endpoint answering deadline-bounded allow/deny verdicts
  from severity policy, with a verdict cache keyed by the findings-
  memo ``ctx_sig`` so ``db update`` hot swaps invalidate admission
  answers exactly like findings entries.
"""

from .admission import (AdmissionController, AdmissionPolicy,
                        AdmissionUnavailable, MalformedReview,
                        Verdict, VerdictCache, images_from_review,
                        severity_counts)
from .loop import WatchConfig, WatchLoop
from .metrics import WATCH_METRICS, WatchMetrics
from .source import (Cursor, EventSource, PushEvent,
                     SyntheticSource, TraceSource, WebhookSource,
                     dir_resolver, make_event_storm,
                     parse_notification)

__all__ = [
    "AdmissionController", "AdmissionPolicy", "AdmissionUnavailable",
    "Cursor", "EventSource", "MalformedReview", "PushEvent",
    "SyntheticSource", "TraceSource", "Verdict", "VerdictCache",
    "WATCH_METRICS", "WatchConfig", "WatchLoop", "WatchMetrics",
    "WebhookSource", "dir_resolver", "images_from_review",
    "make_event_storm", "parse_notification", "severity_counts",
]
