"""Per-device busy/idle timeline reconstruction with typed idle
attribution (reference: ``trivy_tpu/obs/timeline.py``).

The raw phase totals of a run say only THAT the device idles, not
WHY. This module rebuilds the device's busy/idle timeline from the
span trees the tracer already records and attributes **every** idle
instant to a typed cause:

==================  =================================================
cause               the device was idle because ...
==================  =================================================
``upload_serialized``  a host→device table/segment upload ran
                       (``h2d_upload`` / ``db_upload`` /
                       ``dfa_upload`` spans) AND that upload span
                       never overlapped device compute — it truly
                       serialized against an idle device. An upload
                       that ran concurrently with a busy span is a
                       PIPELINED upload (the async runtime's
                       double-buffered staging) and is excluded
                       from this cause entirely: the idle it covers
                       falls through to the next matching cause
``fetch_serialized``   streaming-ingest staging ran (``fetch`` /
                       ``decompress`` spans, artifact/stream.py)
                       with zero device overlap — the same
                       pipelined-vs-serialized rule as uploads: a
                       fetch concurrent with device compute is
                       excluded from this cause entirely
``host_pack_bound``    the host was producing the next batch
                       (``pack`` / ``analyze`` / ``join`` /
                       ``memo_lookup`` / ``layer_analyze`` /
                       ``delta_rematch`` spans)
``collect_bound``      the host was consuming the previous batch
                       (``decode`` / ``report`` / ``finish`` /
                       ``memo_store`` spans)
``slot_wait``          the dispatch ring was full — the executor
                       parked waiting for the drain thread to free
                       a slot (runtime/ring.py); the pipeline is
                       collection-gated, not work-starved
``dispatch_gap``       work was admitted — an open dispatch window
                       (``device`` span) or queued work
                       (``queue_wait`` / ``coalesce``) — but no
                       tracked host phase covers the instant: pure
                       dispatch-path overhead (dedup, rank-space
                       build, result fan-out, Python glue)
``queue_empty``        no request was open at all — the scanner was
                       genuinely idle
``unknown``            a request was open but nothing tracked was
                       running (the honesty bucket)
==================  =================================================

Causes can overlap (the host packs batch N+1 while requests queue);
each idle instant goes to the HIGHEST-priority overlapping cause, in
the order above — so the attribution is a partition: the per-cause
seconds always sum to the idle wall exactly, with no overlap and no
negative gap (property-tested against the reference in
tests/test_torch_obs_timeline.py).

Device **busy** is the union of the actual kernel-execution spans
(``device_compute``, ``dfa_scan``) — NOT the scheduler's per-request
``device`` dispatch windows, which bracket host packing and decode
too; those windows are what ``dispatch_gap`` is measured against. On
a card the busy spans carry the stamps of CUDA events recorded around
the work (``obs/busy.py``), so busy is when the card ran it, not when
the host enqueued it.

Clock discipline: every timestamp here is ``time.monotonic`` (the
spans' ``start_mono``/``end_mono``). Wall clock is labels-only
throughout ``obs/`` — a wall step (NTP slew, leap smear) mid-batch
must not move a single attributed microsecond.
"""

from __future__ import annotations

# span names that mean the device itself was executing
DEVICE_BUSY = frozenset({"device_compute", "dfa_scan"})

# cause -> the span names whose coverage attributes an idle instant
# to it, in PRIORITY order (first match wins inside a gap)
CAUSE_SPANS = (
    ("upload_serialized", frozenset({"h2d_upload", "db_upload",
                                     "dfa_upload"})),
    # streaming-ingest staging (artifact/stream.py): registry blob
    # fetch + bounded inflate. Same overlapped-span rule as uploads —
    # a fetch running while the device computes is pipelined staging,
    # excluded from this cause entirely
    ("fetch_serialized", frozenset({"fetch", "decompress"})),
    # memo_lookup (hit/miss partition) and delta_rematch (hot-swap
    # migration) are host work that gates the next dispatch;
    # memo_store is finish-side bookkeeping (memo/findings.py);
    # layer_analyze is the per-layer walk+analyzer stage of the
    # streaming pipeline (a sub-phase of analyze)
    ("host_pack_bound", frozenset({"pack", "analyze", "join",
                                   "memo_lookup", "layer_analyze",
                                   "delta_rematch"})),
    ("collect_bound", frozenset({"decode", "verify", "report",
                                 "finish", "memo_store"})),
    # ring-full stalls of the async slot runtime (runtime/ring.py):
    # below collect_bound (a full ring usually IS the collect side
    # running behind) but above the catch-all dispatch_gap
    ("slot_wait", frozenset({"slot_wait"})),
    ("dispatch_gap", frozenset({"device", "queue_wait",
                                "coalesce"})),
)

# upload spans get the overlapped-upload treatment (see the table
# above): only spans in this set that never ran concurrently with a
# busy interval count toward upload_serialized
_UPLOAD_SPANS = CAUSE_SPANS[0][1]

# causes whose spans are pipelined staging when they overlap device
# compute — only the zero-busy-overlap spans keep their cause
# priority
_SERIALIZED_ONLY_CAUSES = frozenset({"upload_serialized",
                                     "fetch_serialized"})

# any open root ("scan") span means the scanner had work somewhere;
# idle not explained above becomes unknown instead of queue_empty
_ROOT = "scan"

CAUSES = tuple(c for c, _ in CAUSE_SPANS) + ("queue_empty",
                                             "unknown")


def _merge(intervals: list) -> list:
    """Sorted union of (start, end) intervals; empty/negative
    intervals dropped."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: list = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _complement(intervals: list, lo: float, hi: float) -> list:
    """[lo, hi] minus the (merged) intervals."""
    out = []
    cur = lo
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def _clip(intervals: list, lo: float, hi: float) -> list:
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append((s, e))
    return out


def _overlap_s(intervals: list, lo: float, hi: float) -> float:
    return sum(e - s for s, e in _clip(intervals, lo, hi))


class Timeline:
    """One reconstruction over a list of finished spans.

    ``attribute()`` returns the partitioned idle breakdown;
    ``report()`` the JSON-able summary. The input spans only need
    ``name``, ``start_mono``, ``end_mono`` and ``attrs`` — a real
    ``obs.trace.Span``, or any duck-typed stand-in (the property
    tests use a namedtuple)."""

    def __init__(self, spans: list, window=None):
        done = [s for s in spans
                if getattr(s, "end_mono", None) is not None
                and not getattr(s, "noop", False)]
        self.spans = done
        if window is not None:
            self.t0, self.t1 = float(window[0]), float(window[1])
        elif done:
            self.t0 = min(s.start_mono for s in done)
            self.t1 = max(s.end_mono for s in done)
        else:
            self.t0 = self.t1 = 0.0
        by_name: dict = {}
        for s in done:
            by_name.setdefault(s.name, []).append(
                (s.start_mono, s.end_mono))
        self._busy = _merge([iv for n in DEVICE_BUSY
                             for iv in by_name.get(n, ())])
        self._cause_ivs = [
            (cause,
             _merge(self._serialized_only(
                 [iv for n in names for iv in by_name.get(n, ())]))
             if cause in _SERIALIZED_ONLY_CAUSES else
             _merge([iv for n in names
                     for iv in by_name.get(n, ())]))
            for cause, names in CAUSE_SPANS]
        self._open = _merge(by_name.get(_ROOT, []))
        # batch ids: gaps are attached to the NEXT busy interval's
        # covering dispatch span, so "why did batch 17 start late"
        # is answerable per batch
        self._batch_spans = sorted(
            ((s.start_mono, s.end_mono, s.attrs.get("batch"))
             for s in done
             if s.name == "device" and s.attrs.get("batch")
             is not None),
            key=lambda t: t[0])

    def _serialized_only(self, uploads: list) -> list:
        """Overlapped-upload rule: an upload span that ran (with
        positive measure) while the device computed is a PIPELINED
        upload — the double-buffered staging the async runtime
        exists to produce — and must not claim ``upload_serialized``
        priority over the idle instants it happens to cover. Only
        spans with zero busy overlap survive into the cause set; a
        dropped span's idle coverage falls through to the next
        matching cause, so the partition stays exact."""
        return [iv for iv in uploads
                if _overlap_s(self._busy, iv[0], iv[1]) <= 0.0]

    # --- the partition ---

    def attribute(self) -> dict:
        """{cause: seconds} — partitions the idle wall exactly."""
        out = {c: 0.0 for c in CAUSES}
        for lo, hi in self.idle_intervals():
            for cause, dur in self._attribute_gap(lo, hi):
                out[cause] += dur
        return out

    def _attribute_gap(self, lo: float, hi: float) -> list:
        return [(cause, b - a)
                for cause, a, b in self.gap_pieces(lo, hi)]

    def gap_pieces(self, lo: float, hi: float) -> list:
        """Partition one idle gap into positioned (cause, a, b)
        pieces: sweep the elementary sub-intervals between all cause
        boundaries, assigning each to its highest-priority cover.
        The positions let the fleet merge re-split pieces against
        peer busy intervals without breaking the partition."""
        pts = {lo, hi}
        for _, ivs in self._cause_ivs:
            for s, e in _clip(ivs, lo, hi):
                pts.add(s)
                pts.add(e)
        for s, e in _clip(self._open, lo, hi):
            pts.add(s)
            pts.add(e)
        edges = sorted(pts)
        out = []
        for a, b in zip(edges, edges[1:]):
            mid = (a + b) / 2.0
            cause = None
            for name, ivs in self._cause_ivs:
                if any(s <= mid < e for s, e in ivs):
                    cause = name
                    break
            if cause is None:
                cause = "unknown" if any(
                    s <= mid < e for s, e in self._open) \
                    else "queue_empty"
            out.append((cause, a, b))
        return out

    # --- intervals ---

    def busy_intervals(self) -> list:
        return _clip(self._busy, self.t0, self.t1)

    def idle_intervals(self) -> list:
        return _complement(self.busy_intervals(), self.t0, self.t1)

    # --- summaries ---

    @property
    def window_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    @property
    def idle_s(self) -> float:
        return sum(e - s for s, e in self.idle_intervals())

    def per_batch(self) -> list:
        """[{batch, wait_s, attribution}] — each idle gap charged to
        the batch whose dispatch window it delayed (the next busy
        interval's covering ``device`` span). Gaps after the last
        batch land on batch=None."""
        busy = self.busy_intervals()
        out: dict = {}
        for lo, hi in self.idle_intervals():
            nxt = next((s for s, _ in busy if s >= hi), None)
            batch = None
            if nxt is not None:
                for s, e, b in self._batch_spans:
                    if s <= nxt < e:
                        batch = b
                        break
            slot = out.setdefault(batch, {
                "batch": batch, "wait_s": 0.0,
                "attribution": {c: 0.0 for c in CAUSES}})
            slot["wait_s"] += hi - lo
            for cause, dur in self._attribute_gap(lo, hi):
                slot["attribution"][cause] += dur
        return [out[k] for k in sorted(
            out, key=lambda b: (b is None, b))]

    def report(self, per_batch: bool = False) -> dict:
        """The JSON-able breakdown. ``coverage`` is the share of idle
        wall attributed to a KNOWN cause (1 - unknown/idle)."""
        attr = self.attribute()
        idle = self.idle_s
        out = {
            "window_s": round(self.window_s, 6),
            "busy_s": round(self.busy_s, 6),
            "idle_s": round(idle, 6),
            "busy_ratio": round(self.busy_s / self.window_s, 4)
            if self.window_s else 0.0,
            "attribution": {c: round(v, 6)
                            for c, v in attr.items()},
            "coverage": round(1.0 - attr["unknown"] / idle, 4)
            if idle > 0 else 1.0,
            "gaps": len(self.idle_intervals()),
        }
        if per_batch:
            out["per_batch"] = [
                {"batch": b["batch"],
                 "wait_s": round(b["wait_s"], 6),
                 "attribution": {c: round(v, 6)
                                 for c, v in
                                 b["attribution"].items() if v}}
                for b in self.per_batch()]
        return out


def from_recorder(recorder, window=None) -> Timeline:
    """Timeline over every span in the flight-recorder ring — the
    fleet-run entry (a fleet's traces all complete into the ring;
    size the ring to the fleet)."""
    spans = [s for _, trace in recorder.traces() for s in trace]
    return Timeline(spans, window=window)


def from_tracer(tracer, window=None) -> Timeline:
    return from_recorder(tracer.recorder, window=window)


# --- fleet merge ----------------------------------------------------
#
# N processes export their spans (plus their monotonic epoch), the
# coordinator estimates pairwise clock offsets
# (obs/propagate.py::estimate_offset) and merges everything onto ONE
# aligned monotonic axis. Each host
# keeps its own exact partition; the only new cause is
# ``peer_straggler`` — idle a host spent with no local explanation
# while some OTHER host's device was still busy, i.e. waiting on the
# slowest shard. It is carved out of queue_empty/unknown by
# re-splitting those pieces against the union of peer busy
# intervals, so per-host sum(causes) == idle still holds exactly.

FLEET_CAUSES = CAUSES + ("peer_straggler",)

# pieces eligible for peer_straggler reattribution: causes with a
# LOCAL explanation (uploads, host phases, ring stalls) keep their
# attribution even while a peer lags — only "nothing local was
# happening" time can be the fault of the slowest shard
_PEER_ELIGIBLE = frozenset({"queue_empty", "unknown"})


class SpanLite:
    """Deserialized exported span — duck-types the Span fields
    :class:`Timeline` reads, with the host's estimated clock offset
    already applied to both timestamps."""

    noop = False
    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "start_mono", "end_mono", "status", "attrs",
                 "is_root")

    def __init__(self, doc: dict, offset_s: float = 0.0):
        self.name = str(doc.get("name") or "")
        self.trace_id = str(doc.get("trace_id") or "")
        self.span_id = str(doc.get("span_id") or "")
        self.parent_id = doc.get("parent_id") or None
        self.start_mono = float(doc.get("start_mono") or 0.0) \
            + offset_s
        end = doc.get("end_mono")
        self.end_mono = None if end is None \
            else float(end) + offset_s
        self.status = str(doc.get("status") or "ok")
        attrs = doc.get("attrs")
        self.attrs = dict(attrs) if isinstance(attrs, dict) else {}
        self.is_root = bool(doc.get("is_root",
                                    self.parent_id is None))


def export_spans(spans: list, process: str = "",
                 epoch_mono: float = 0.0) -> dict:
    """JSON-able export of finished spans + the process's monotonic
    epoch — the unit the simhost output file and the federate
    snapshot carry. Attrs are filtered to JSON scalars."""
    out = []
    for s in spans:
        if getattr(s, "end_mono", None) is None \
                or getattr(s, "noop", False):
            continue
        out.append({
            "name": s.name,
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "start_mono": s.start_mono,
            "end_mono": s.end_mono,
            "status": getattr(s, "status", "ok"),
            "is_root": bool(getattr(s, "is_root",
                                    s.parent_id is None)),
            "attrs": {k: v for k, v in
                      getattr(s, "attrs", {}).items()
                      if isinstance(v, (str, int, float, bool))},
        })
    return {"process": str(process),
            "epoch_mono": float(epoch_mono),
            "spans": out}


def export_tracer(tracer, process: str = "") -> dict:
    """Export every completed trace in a tracer's recorder ring."""
    spans = [s for _, trace in tracer.recorder.traces()
             for s in trace]
    return export_spans(spans, process=process,
                        epoch_mono=tracer.epoch_mono)


def load_export(doc: dict, offset_s: float = 0.0) -> list:
    """Hydrate one export back into Timeline-compatible spans, with
    ``offset_s`` (local ≈ remote + offset, as
    ``obs/propagate.py::estimate_offset`` estimates it) applied."""
    return [SpanLite(d, offset_s=offset_s)
            for d in (doc.get("spans") or [])]


class MergedTimeline:
    """N per-process exports on one aligned monotonic axis.

    ``exports`` are :func:`export_spans` documents; ``offsets`` are
    the per-export clock offsets mapping each host's monotonic
    timestamps onto the coordinator's axis (local ≈ remote +
    offset). The fleet window defaults to the union extent of all
    hosts' spans so trailing idle on fast hosts — the straggler
    signal — stays in frame."""

    def __init__(self, exports: list, offsets=None, window=None):
        offsets = list(offsets) if offsets is not None \
            else [0.0] * len(exports)
        if len(offsets) != len(exports):
            raise ValueError("one offset per export required")
        self.hosts = []
        for i, (doc, off) in enumerate(zip(exports, offsets)):
            name = str(doc.get("process") or f"host{i}")
            self.hosts.append((name, load_export(doc,
                                                 offset_s=off)))
        extents = [Timeline(spans) for _, spans in self.hosts]
        with_spans = [t for t in extents if t.spans]
        if window is not None:
            self.t0, self.t1 = float(window[0]), float(window[1])
        elif with_spans:
            self.t0 = min(t.t0 for t in with_spans)
            self.t1 = max(t.t1 for t in with_spans)
        else:
            self.t0 = self.t1 = 0.0
        self.timelines = [
            (name, Timeline(spans, window=(self.t0, self.t1)))
            for name, spans in self.hosts]

    @property
    def window_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def per_host(self) -> list:
        """[{process, busy_s, idle_s, attribution, coverage,
        last_busy_end_s}] — each host's exact partition over the
        COMMON fleet window, with peer_straggler carved out of
        unexplained idle covered by some other host's busy time."""
        busy_by_host = [tl.busy_intervals()
                        for _, tl in self.timelines]
        out = []
        for i, (name, tl) in enumerate(self.timelines):
            peers_busy = _merge([iv
                                 for j, ivs in
                                 enumerate(busy_by_host)
                                 if j != i for iv in ivs])
            attr = {c: 0.0 for c in FLEET_CAUSES}
            for lo, hi in tl.idle_intervals():
                for cause, a, b in tl.gap_pieces(lo, hi):
                    if cause in _PEER_ELIGIBLE:
                        covered = _overlap_s(peers_busy, a, b)
                        attr["peer_straggler"] += covered
                        attr[cause] += (b - a) - covered
                    else:
                        attr[cause] += b - a
            busy = tl.busy_s
            idle = tl.idle_s
            last = max((e for _, e in busy_by_host[i]),
                       default=self.t0)
            out.append({
                "process": name,
                "busy_s": round(busy, 6),
                "idle_s": round(idle, 6),
                "attribution": {c: round(v, 6)
                                for c, v in attr.items()},
                "coverage": round(1.0 - attr["unknown"] / idle, 4)
                if idle > 0 else 1.0,
                "last_busy_end_s": round(last - self.t0, 6),
            })
        return out

    def report(self) -> dict:
        """Fleet summary + the per-host burn-down list (hosts sorted
        by when their device went quiet, latest first — who the
        straggler was)."""
        hosts = self.per_host()
        idle = sum(h["idle_s"] for h in hosts)
        unknown = sum(h["attribution"]["unknown"] for h in hosts)
        fleet_attr = {c: round(sum(h["attribution"][c]
                                   for h in hosts), 6)
                      for c in FLEET_CAUSES}
        return {
            "window_s": round(self.window_s, 6),
            "hosts": hosts,
            "fleet": {
                "busy_s": round(sum(h["busy_s"] for h in hosts),
                                6),
                "idle_s": round(idle, 6),
                "attribution": fleet_attr,
                "coverage": round(1.0 - unknown / idle, 4)
                if idle > 0 else 1.0,
            },
            "burn_down": [
                {"process": h["process"],
                 "finished_at_s": h["last_busy_end_s"],
                 "busy_s": h["busy_s"],
                 "peer_straggler_s":
                     h["attribution"]["peer_straggler"]}
                for h in sorted(hosts,
                                key=lambda h:
                                -h["last_busy_end_s"])],
        }
