"""Push-event sources for the watch loop (copied from
``trivy_tpu/watch/source.py``; docs/serving.md
"Continuous scanning & admission control").

Three sources share one contract — ``get(timeout) -> PushEvent|None``
plus ``exhausted`` — so the loop never cares where events come from:

* :class:`WebhookSource` — the real one: a bounded queue fed by the
  server's ``POST /registry/notifications`` route with Docker
  Registry v2 notification envelopes (the ``notifications`` webhook a
  registry is configured to POST on every push);
* :class:`SyntheticSource` — a seeded Poisson arrival schedule over a
  fleet of image tarballs, with duplicate-tag bursts, for tests and
  ``watch --watch-source synthetic``;
* :class:`TraceSource` — replays a recorded event list verbatim.

Every event carries a monotonically increasing per-source ``seq``;
the loop acks seqs as events resolve and a :class:`Cursor`
checkpoints the contiguous high-water mark, so a restarted watch
resumes where it left off instead of re-scanning the backlog.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .metrics import WATCH_METRICS

log = logging.getLogger("trivy_tpu_torch.watch.source")

# media types that mean "a manifest was pushed" (Docker Registry v2
# notification envelope, registry/notifications/event.go) — blob
# (layer) pushes also arrive and are NOT scan triggers
MANIFEST_MEDIA_TYPES = (
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.oci.image.index.v1+json",
)


@dataclass
class PushEvent:
    """One registry push, normalized. ``digest`` is the dedupe key —
    a tag repushed five times in a burst carries the same digest and
    scans once."""

    digest: str
    ref: str = ""              # repository[:tag] for display/resolve
    path: str = ""             # resolvable scan target (tarball)
    tenant: str = ""
    priority: int = 0
    seq: int = -1              # per-source cursor position
    event_id: str = ""
    # propagated trace context (fleet plane): a traceparent on the
    # notification envelope rides every event it yields, so the scan
    # the watcher submits joins the submitter's trace
    traceparent: str = ""
    ts: float = field(default_factory=time.monotonic)


def parse_notification(body, resolver=None, tenant: str = "",
                       priority: int = 0) -> tuple:
    """Docker Registry v2 notification envelope → ``(events,
    malformed)``. Only manifest *push* actions become events;
    entries missing a digest or repository — or a non-dict envelope —
    count as malformed and are dropped (never raised: a registry
    webhook retries on non-2xx, and a poison notification must not
    wedge the stream)."""
    events, malformed = [], 0
    if not isinstance(body, dict) or \
            not isinstance(body.get("events"), list):
        WATCH_METRICS.inc("malformed")
        return events, 1
    traceparent = str(body.get("traceparent") or "")
    for ev in body["events"]:
        if not isinstance(ev, dict):
            malformed += 1
            continue
        if ev.get("action") != "push":
            continue             # pulls/deletes: ignored, not malformed
        target = ev.get("target") or {}
        media = target.get("mediaType", "")
        if media and media not in MANIFEST_MEDIA_TYPES:
            continue             # blob push: every layer fires one
        repo = target.get("repository")
        digest = target.get("digest")
        if not isinstance(repo, str) or not repo or \
                not isinstance(digest, str) or not digest:
            malformed += 1
            continue
        tag = target.get("tag") or ""
        ref = f"{repo}:{tag}" if tag else repo
        path = resolver(ref, digest) if resolver is not None else ""
        events.append(PushEvent(digest=digest, ref=ref,
                                path=path or "", tenant=tenant,
                                priority=priority,
                                event_id=str(ev.get("id") or ""),
                                traceparent=traceparent))
    if malformed:
        WATCH_METRICS.inc("malformed", malformed)
    return events, malformed


def dir_resolver(images_dir: str):
    """``--images-dir`` resolver: image ref → local tarball via the
    ``k8s --images-dir`` naming contract (one shared helper, no
    second copy to drift)."""
    from ..k8s import resolve_image_ref

    def resolve(ref: str, digest: str = ""):
        return resolve_image_ref(images_dir, ref)

    return resolve


class EventSource:
    """Base contract. ``get`` may raise on transport failure — the
    loop survives via the shared backoff policy."""

    def get(self, timeout: float = 0.05):
        raise NotImplementedError

    def take_dropped(self) -> tuple:
        """Seqs of events this source discarded before delivery
        (webhook overflow). The loop acks them so the checkpoint
        cursor never freezes on a hole no event will ever fill."""
        return ()

    @property
    def exhausted(self) -> bool:
        return False

    def resume_from(self, position: int) -> None:
        """Skip events with ``seq <= position`` (checkpoint resume).
        Non-replayable sources (webhook) only fast-forward their seq
        counter so cursor positions stay monotonic across restarts."""

    def close(self) -> None:
        pass


class WebhookSource(EventSource):
    """Bounded thread-safe queue fed by the server's
    ``POST /registry/notifications`` route. A full queue drops the
    oldest events (the registry redelivers on its own schedule;
    unbounded buffering is how a push storm becomes an OOM)."""

    def __init__(self, resolver=None, maxsize: int = 4096,
                 tenant: str = "", priority: int = 0):
        self.resolver = resolver
        self.tenant = tenant
        self.priority = priority
        self._q: deque = deque(maxlen=max(16, maxsize))
        self._cv = threading.Condition()
        self._seq = 0
        self._closed = False
        self.dropped = 0
        self._dropped_seqs: list = []

    def push_notification(self, body) -> dict:
        """Ingest one notification envelope (the HTTP route calls
        this). Returns ``{"accepted": n, "malformed": m}`` — always,
        so the webhook answers 200 and the registry never retries a
        poison envelope forever."""
        events, malformed = parse_notification(
            body, resolver=self.resolver, tenant=self.tenant,
            priority=self.priority)
        with self._cv:
            for ev in events:
                ev.seq = self._seq
                self._seq += 1
                if len(self._q) == self._q.maxlen:
                    # overflow evicts the OLDEST undelivered event;
                    # its seq is remembered so the loop can still
                    # ack it — otherwise the checkpoint cursor would
                    # freeze on the hole forever
                    self.dropped += 1
                    self._dropped_seqs.append(self._q[0].seq)
                self._q.append(ev)
            self._cv.notify_all()
        return {"accepted": len(events), "malformed": malformed,
                "dropped": self.dropped}

    def push_events(self, events) -> int:
        """Enqueue already-built :class:`PushEvent`\\ s (the impact
        push stream's entry point) with the same seq-assignment and
        bounded-overflow semantics as webhook notifications — a swap
        storm buffers bounded and folds into the loop's debounce like
        any other burst."""
        events = list(events)
        with self._cv:
            for ev in events:
                ev.seq = self._seq
                self._seq += 1
                if len(self._q) == self._q.maxlen:
                    self.dropped += 1
                    self._dropped_seqs.append(self._q[0].seq)
                self._q.append(ev)
            self._cv.notify_all()
        return len(events)

    def get(self, timeout: float = 0.05):
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            return self._q.popleft() if self._q else None

    def take_dropped(self) -> tuple:
        with self._cv:
            out, self._dropped_seqs = tuple(self._dropped_seqs), []
            return out

    @property
    def exhausted(self) -> bool:
        with self._cv:
            return self._closed and not self._q

    def resume_from(self, position: int) -> None:
        with self._cv:
            self._seq = max(self._seq, position + 1)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class TraceSource(EventSource):
    """Replays a recorded list of :class:`PushEvent` in order.
    Deterministic and unpaced — the unit-test workhorse."""

    def __init__(self, events: list):
        self._events = list(events)
        for i, ev in enumerate(self._events):
            if ev.seq < 0:
                ev.seq = i
        self._i = 0

    def get(self, timeout: float = 0.05):
        if self._i >= len(self._events):
            return None
        ev = self._events[self._i]
        self._i += 1
        ev.ts = time.monotonic()
        return ev

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._events)

    def resume_from(self, position: int) -> None:
        while self._i < len(self._events) and \
                self._events[self._i].seq <= position:
            self._i += 1


class SyntheticSource(EventSource):
    """Seeded open-loop arrival schedule over a fleet of tarballs:
    Poisson gaps at ``rate`` events/s, with ``dup_rate`` of events
    followed by a burst of duplicate pushes of the same digest (the
    tag-repush pattern debounce exists for). ``paced=False`` replays
    the same schedule as fast as the loop pulls — the CLI paces,
    unit tests don't."""

    def __init__(self, paths: list, rate: float = 10.0,
                 n_events: int = 0, seed: int = 20260804,
                 dup_rate: float = 0.25, burst: int = 4,
                 paced: bool = True, tenant: str = "",
                 priority: int = 0):
        import hashlib
        import random
        rng = random.Random(seed)
        n = n_events or len(paths)
        sched: list = []           # (due offset, PushEvent)
        t = 0.0
        seq = 0
        while len(sched) < n:
            t += rng.expovariate(max(rate, 1e-6))
            path = paths[rng.randrange(len(paths))]
            digest = "sha256:" + hashlib.sha256(
                path.encode()).hexdigest()
            ref = os.path.basename(path)
            k = 1
            if rng.random() < dup_rate:
                k += rng.randrange(1, max(2, burst))
            for j in range(k):
                if len(sched) >= n:
                    break
                sched.append((t + j * 0.001, PushEvent(
                    digest=digest, ref=ref, path=path,
                    tenant=tenant, priority=priority, seq=seq,
                    event_id=f"synth-{seq}")))
                seq += 1
        self._sched = sched
        self._i = 0
        self.paced = paced
        self._t0 = None

    def get(self, timeout: float = 0.05):
        if self._i >= len(self._sched):
            return None
        if self._t0 is None:
            self._t0 = time.monotonic()
        due, ev = self._sched[self._i]
        if self.paced:
            now = time.monotonic() - self._t0
            if due > now:
                time.sleep(min(timeout, due - now))
                now = time.monotonic() - self._t0
                if due > now:
                    return None
        self._i += 1
        ev.ts = time.monotonic()
        return ev

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._sched)

    def resume_from(self, position: int) -> None:
        while self._i < len(self._sched) and \
                self._sched[self._i][1].seq <= position:
            self._i += 1


def make_event_storm(spec, paths: list) -> list:
    """The ``event-storm`` fault scenario's payload: a seeded burst
    of ``storm_events`` raw notification envelopes over
    ``storm_digests`` distinct digests (duplicate-tag repushes
    included), with ``storm_malformed`` malformed envelopes
    interleaved. The harness (tests, ``watch --fault-spec``) feeds these through
    ``WebhookSource.push_notification`` — debounce must collapse the
    duplicates, malformed envelopes must be counted and dropped, and
    scheduler backpressure must shed via the existing 429/503 paths
    without ever crashing the loop."""
    import hashlib
    import random
    rng = random.Random(spec.seed)
    digests = max(1, min(spec.storm_digests or 1, len(paths)))
    chosen = paths[:digests]
    out = []
    malformed_budget = max(0, spec.storm_malformed)
    n = max(1, spec.storm_events)
    malformed_at = set(rng.sample(range(n + malformed_budget),
                                  malformed_budget)) \
        if malformed_budget else set()
    i = ev = 0
    while ev < n or len(out) < n + malformed_budget:
        if i in malformed_at:
            out.append(rng.choice([
                {"events": "not-a-list"},
                {"events": [{"action": "push", "target": {}}]},
                {"events": [{"action": "push",
                             "target": {"repository": "r"}}]},
                ["not", "an", "envelope"],
            ]))
        else:
            if ev >= n:
                i += 1
                continue
            path = chosen[ev % digests]
            digest = "sha256:" + hashlib.sha256(
                path.encode()).hexdigest()
            tag = f"v{rng.randrange(3)}"     # tag churn, same digest
            out.append({"events": [{
                "id": f"storm-{ev}", "action": "push",
                "target": {"mediaType": MANIFEST_MEDIA_TYPES[0],
                           "repository": os.path.basename(path),
                           "tag": tag, "digest": digest,
                           "path": path}}]})
            ev += 1
        i += 1
    return out


def _checkpoint_crc(position: int) -> int:
    """Integrity tag for the checkpoint doc. A torn write or a
    flipped byte in ``position`` can still parse as valid JSON with
    a LARGER int — and a cursor that believes it would *skip unacked
    events* on resume, the one failure mode worse than replay."""
    import zlib
    return zlib.crc32(f"position:{int(position)}".encode())


# out-of-order ack window: seqs acked above a hole the stream never
# fills (e.g. an event lost without a drop record). Past the cap the
# oldest hole is declared abandoned and the cursor advances — a
# bounded replay-on-restart beats an unbounded set (the soak leak
# audit samples this window).
ACK_WINDOW_CAP = 65536


class Cursor:
    """Checkpointed stream position: ``ack(seq)`` as events resolve,
    ``position`` is the highest seq with every seq at or below it
    acked — a restart resumes AFTER it, never re-scanning work that
    already completed. Persistence is atomic (tmp + rename), like
    every other on-disk artifact in this tree, and the doc carries a
    CRC so a torn or bit-flipped checkpoint degrades to replay
    instead of crashing the loop or (worse) skipping unacked
    events."""

    def __init__(self, path: str = "",
                 ack_window: int = ACK_WINDOW_CAP):
        self.path = path
        self._lock = threading.Lock()
        self._pos = -1
        self._acked: set = set()
        self._ack_window = max(16, int(ack_window))
        self.abandoned = 0       # holes declared lost at the cap
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
                self._pos = self._validate(doc)
            except (OSError, ValueError, TypeError) as e:
                # a torn checkpoint must degrade to "replay from the
                # start" — correctness is dedupe's job, the cursor
                # only saves work
                log.warning("unreadable watch checkpoint %s: %r",
                            path, e)

    @staticmethod
    def _validate(doc) -> int:
        """Checkpoint doc → position, raising ValueError on anything
        suspect. Accepts the legacy ``{"position": N}`` shape (no
        CRC, exactly one key); any other shape must carry a matching
        ``crc`` — unknown keys or a stale/flipped tag mean the file
        was damaged in a way JSON parsing can't see."""
        if not isinstance(doc, dict):
            raise ValueError(f"checkpoint is {type(doc).__name__}, "
                             "not an object")
        pos = doc.get("position", -1)
        if isinstance(pos, bool) or not isinstance(pos, int):
            raise ValueError(f"bad checkpoint position {pos!r}")
        if set(doc) == {"position"}:
            return pos           # legacy, pre-CRC checkpoint
        if set(doc) != {"position", "crc"} or \
                doc["crc"] != _checkpoint_crc(pos):
            raise ValueError("checkpoint integrity check failed")
        return pos

    @property
    def position(self) -> int:
        with self._lock:
            return self._pos

    def stats(self) -> dict:
        """Leak-audit surface: the out-of-order window size is the
        one thing here that can grow."""
        with self._lock:
            return {"position": self._pos,
                    "ack_window": len(self._acked),
                    "abandoned": self.abandoned}

    def ack(self, seq: int) -> None:
        with self._lock:
            if seq <= self._pos:
                return
            self._acked.add(seq)
            advanced = False
            while self._pos + 1 in self._acked:
                self._pos += 1
                self._acked.discard(self._pos)
                advanced = True
            if len(self._acked) > self._ack_window:
                # a hole nothing will ever fill: advance past it to
                # the oldest acked seq (bounded memory; the skipped
                # range replays on restart, which is safe — dedupe
                # and idempotency absorb re-scans)
                jump = min(self._acked)
                log.warning(
                    "watch cursor abandoning hole %d..%d "
                    "(ack window %d over cap)", self._pos + 1,
                    jump - 1, len(self._acked))
                self.abandoned += jump - self._pos - 1
                self._pos = jump
                self._acked.discard(jump)
                while self._pos + 1 in self._acked:
                    self._pos += 1
                    self._acked.discard(self._pos)
                advanced = True
        if advanced:
            self.save()

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            doc = {"position": self._pos,
                   "crc": _checkpoint_crc(self._pos)}
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError as e:        # checkpointing is best-effort
            log.warning("watch checkpoint write failed: %r", e)
