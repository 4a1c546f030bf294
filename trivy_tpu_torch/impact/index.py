"""The inverted findings index: (package, CVE) → affected layer
digests → images/tenants (reference: ``trivy_tpu/impact/index.py``;
docs/serving.md "CVE impact queries & push re-scans").

The memo tier already holds, per content-addressed layer, the
exact detection verdicts a scan served — as *indices* into the
candidate-advisory rows a generation compiles. This module inverts
that: :func:`entry_postings` rebuilds a memo entry's candidate rows
exactly the way the delta re-match does (detect/rematch.py), reads
the verdict indices back as ``(bucket, pkg, Advisory)`` row metadata,
and yields the ``(package, CVE)`` pairs the layer is affected by.
One function drives BOTH the incremental write-through (memo store /
hot-swap hooks in memo/findings.py) and the brute-force inversion
(:func:`brute_force_invert`), so the property test's byte-identity
holds by construction, not by luck.

Sharding: the index carries an optional ``owns(layer_digest)``
predicate — the router's consistent-hash ring slice. Ingest is
unfiltered (a replica indexes what its memo sees), queries and
snapshots filter to the owned slice, and the fleet answer is the
federated union of slices (impact/federate.py). On a reshard the
successor re-arms ``owns`` with its new slice and :meth:`rebuild`\\ s
from the shared memo tier — exactness is the kill-one-replica test.

Image records (image → tenant + layer set) are persisted write-
through to the same memo store under ``impact-``-prefixed keys with
their own checksummed envelope, so a rebuilt replica recovers the
layer→image join without re-scanning anything.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from typing import Optional

from .metrics import IMPACT_METRICS

log = logging.getLogger("trivy_tpu_torch.impact")

# memo keys are 40-hex (memo/keys.make_key); this prefix can never
# collide with one, and stays fs-store path-safe (alnum + dash)
IMPACT_KEY_PREFIX = "impact-"
IMPACT_SCHEMA = 1


def is_impact_key(key: str) -> bool:
    return key.startswith(IMPACT_KEY_PREFIX)


def image_key(image: str) -> str:
    """Store key for one image record — content-addressed so the
    same image always lands on the same key (idempotent put)."""
    h = hashlib.sha256(image.encode("utf-8", "replace")).hexdigest()
    return IMPACT_KEY_PREFIX + h[:40]


def _rec_checksum(payload: dict) -> str:
    data = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(data).hexdigest()[:16]


def encode_image_record(image: str, tenant: str,
                        blobs: list) -> bytes:
    payload = {"v": IMPACT_SCHEMA, "image": image, "tenant": tenant,
               "blobs": sorted(blobs)}
    return json.dumps({"rec": payload,
                       "sum": _rec_checksum(payload)},
                      sort_keys=True,
                      separators=(",", ":")).encode()


def decode_image_record(raw: bytes) -> Optional[dict]:
    """None on any corruption — a torn record degrades to 'image
    unknown until next scan', never an error."""
    try:
        doc = json.loads(raw.decode("utf-8"))
        payload = doc["rec"]
        if doc.get("sum") != _rec_checksum(payload):
            raise ValueError("impact record checksum mismatch")
        if payload.get("v") != IMPACT_SCHEMA:
            raise ValueError("impact record schema mismatch")
        if not isinstance(payload.get("image"), str) or \
                not isinstance(payload.get("blobs"), list):
            raise ValueError("impact record shape")
        return payload
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def entry_postings(entry: dict, cdb) -> tuple:
    """One memo entry → sorted ``((pkg, cve), ...)`` pairs its layer
    is affected by under generation ``cdb``.

    Candidate rows rebuild EXACTLY as detect/rematch.py builds its
    re-match jobs (same driver gating, same ordering), so the stored
    verdict indices address the same rows the live scan's jobs came
    from. Non-compiled stores (fixture AdvisoryStore) have no row
    tables — they yield no postings and the index simply stays empty
    for them."""
    if not hasattr(cdb, "rows_meta"):
        return ()
    from ..detect.rematch import _os_rows
    pairs = set()
    for sub in entry.get("subs", {}).values():
        hits = sub.get("hits") or ()
        if not hits:
            continue
        if sub.get("kind") == "os":
            rows = _os_rows(cdb, sub)
            if rows is None:
                continue
        else:
            rows = cdb.candidate_rows_prefix(sub.get("bucket", ""),
                                             sub.get("name", ""))
        for i in hits:
            if not isinstance(i, int) or not 0 <= i < len(rows):
                continue
            _bucket, pkg, adv = cdb.rows_meta[rows[i]]
            cve = getattr(adv, "vulnerability_id", "")
            if cve:
                pairs.add((pkg, cve))
    return tuple(sorted(pairs))


class ImpactIndex:
    """One replica's slice of the fleet-wide inverted index.

    All state lives under one re-entrant lock; maintenance calls are
    O(entry postings) — they ride the scan/finish path, so the <2%
    overhead budget (``maintenance_s`` against the scan wall) is the
    design constraint, not an afterthought."""

    def __init__(self, store=None, owns=None, name: str = "",
                 pusher=None):
        # store: the shared memo tier (ResilientMemoStore or raw) —
        # image records persist write-through so a successor replica
        # recovers the layer→image join; None = in-memory only
        self.store = store
        self.owns = owns              # ring slice predicate, or None
        self.name = name
        self.pusher = pusher          # impact.push.ImpactPusher
        self.complete = True          # last rebuild's coverage flag
        self._lock = threading.RLock()
        self._entries: dict = {}      # memo key -> (blob, postings)
        self._post: dict = {}         # (pkg, cve) -> {blob: refcount}
        self._cves: dict = {}         # cve -> set(pkg)
        self._images: dict = {}       # image -> (tenant, blobs tuple)
        self._by_blob: dict = {}      # blob -> set(image)

    # ---- ownership ----

    def _owned(self, blob: str) -> bool:
        return self.owns is None or bool(self.owns(blob))

    def set_owner(self, owns) -> None:
        """Re-arm the ring slice (reshard). Postings stay resident —
        only the query-time filter moves, so handing a slice over
        needs no index surgery on the survivor."""
        with self._lock:
            self.owns = owns

    # ---- write-through maintenance ----

    def _unref(self, pair: tuple, blob: str) -> None:
        m = self._post.get(pair)
        if m is None:
            return
        n = m.get(blob, 0) - 1
        if n > 0:
            m[blob] = n
            return
        m.pop(blob, None)
        if not m:
            del self._post[pair]
            pkgs = self._cves.get(pair[1])
            if pkgs is not None:
                pkgs.discard(pair[0])
                if not pkgs:
                    del self._cves[pair[1]]

    def set_entry(self, key: str, blob: str, postings) -> tuple:
        """Install one memo entry's postings; returns the ``(pkg,
        cve)`` pairs that became NEWLY present for ``blob`` (refcount
        0 → 1) — the hot-swap push stream's trigger set. Diffs
        against the prior postings under the same key, so re-storing
        an unchanged entry adds nothing."""
        t0 = time.perf_counter()
        postings = tuple(sorted({tuple(p) for p in postings}))
        added = []
        with self._lock:
            old = self._entries.get(key)
            if old is not None and old[0] != blob:
                # a key can't change blobs (the key encodes it), but
                # defend: fully retire the stale attribution
                for pair in old[1]:
                    self._unref(pair, old[0])
                old = None
            old_set = set(old[1]) if old is not None else set()
            new_set = set(postings)
            for pair in old_set - new_set:
                self._unref(pair, blob)
            for pair in new_set - old_set:
                m = self._post.setdefault(pair, {})
                n = m.get(blob, 0)
                m[blob] = n + 1
                if n == 0:
                    added.append(pair)
                self._cves.setdefault(pair[1], set()).add(pair[0])
            if postings:
                self._entries[key] = (blob, postings)
            else:
                self._entries.pop(key, None)
        IMPACT_METRICS.inc("updates")
        IMPACT_METRICS.add_maintenance(time.perf_counter() - t0)
        return tuple(sorted(added))

    def drop_entry(self, key: str) -> None:
        """Memo entry evicted (corrupt drop, old-generation delete):
        release its postings."""
        t0 = time.perf_counter()
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                for pair in old[1]:
                    self._unref(pair, old[0])
        if old is not None:
            IMPACT_METRICS.inc("drops")
            IMPACT_METRICS.add_maintenance(time.perf_counter() - t0)

    def rename_entry(self, old_key: str, new_key: str) -> None:
        """Hot-swap migration of a delta-untouched entry: same blob,
        same advisory content, new context key — postings carry over
        byte-identically, no re-derivation."""
        if old_key == new_key:
            return
        with self._lock:
            rec = self._entries.pop(old_key, None)
            if rec is not None:
                self._entries[new_key] = rec
        if rec is not None:
            IMPACT_METRICS.inc("renames")

    def observe_image(self, image: str, blob_ids, tenant: str = "",
                      persist: bool = True) -> None:
        """Record (or refresh) one image → layer-set edge. Unchanged
        records skip the store put — a swap-storm of re-scans does
        no redundant tier writes."""
        if not image:
            return
        t0 = time.perf_counter()
        rec = (tenant, tuple(sorted(set(blob_ids))))
        if not rec[1]:
            return
        with self._lock:
            old = self._images.get(image)
            if old == rec:
                changed = False
            else:
                changed = True
                if old is not None:
                    for b in old[1]:
                        imgs = self._by_blob.get(b)
                        if imgs is not None:
                            imgs.discard(image)
                            if not imgs:
                                del self._by_blob[b]
                self._images[image] = rec
                for b in rec[1]:
                    self._by_blob.setdefault(b, set()).add(image)
        if changed:
            IMPACT_METRICS.inc("image_updates")
        if persist and self.store is not None:
            if changed:
                self.store.put(image_key(image),
                               encode_image_record(image, tenant,
                                                   list(rec[1])))
                IMPACT_METRICS.inc("persist_puts")
            else:
                IMPACT_METRICS.inc("persist_skips")
        IMPACT_METRICS.add_maintenance(time.perf_counter() - t0)

    # ---- queries ----

    def query(self, cve: str) -> dict:
        """This replica's slice of "which layers/images does CVE-X
        affect": layers filtered to the owned ring slice, images that
        carry at least one such layer. ``complete`` mirrors the last
        rebuild's coverage — Federator semantics, never an error."""
        IMPACT_METRICS.inc("queries")
        with self._lock:
            blobs = set()
            pkgs = set()
            for pkg in self._cves.get(cve, ()):
                for b in self._post.get((pkg, cve), ()):
                    if self._owned(b):
                        blobs.add(b)
                        pkgs.add(pkg)
            images = {}
            for b in blobs:
                for img in self._by_blob.get(b, ()):
                    images[img] = self._images[img][0]
            complete = self.complete
        return {"cve": cve,
                "packages": sorted(pkgs),
                "layers": sorted(blobs),
                "images": sorted([i, t] for i, t in images.items()),
                "complete": complete}

    def images_for_blobs(self, blobs) -> list:
        """Owned-slice images carrying any of ``blobs`` →
        ``[(image, tenant), ...]`` — the hot-swap push stream's
        payload."""
        with self._lock:
            out = {}
            for b in blobs:
                if not self._owned(b):
                    continue
                for img in self._by_blob.get(b, ()):
                    out[img] = self._images[img][0]
        return sorted(out.items())

    def emit_push(self, blobs) -> int:
        """Newly-affected blobs (a hot swap's delta) → high-priority
        re-scan push events via the attached pusher. No pusher, no
        push — the index itself stays passive."""
        if self.pusher is None or not blobs:
            return 0
        images = self.images_for_blobs(blobs)
        if not images:
            return 0
        n = self.pusher.push(images)
        IMPACT_METRICS.inc("push_batches")
        IMPACT_METRICS.inc("push_images", n)
        return n

    # ---- snapshots / rebuild ----

    def postings_snapshot(self) -> dict:
        """Canonical owned-slice view for byte-identity checks:
        stable ordering, no refcounts (they are maintenance detail,
        not answers)."""
        with self._lock:
            postings = []
            for (pkg, cve), m in sorted(self._post.items()):
                owned = sorted(b for b in m if self._owned(b))
                if owned:
                    postings.append([pkg, cve, owned])
            images = sorted(
                [img, t, list(bs)]
                for img, (t, bs) in self._images.items())
        return {"postings": postings, "images": images}

    def stats(self) -> dict:
        with self._lock:
            out = {"entries": len(self._entries),
                   "pairs": len(self._post),
                   "cves": len(self._cves),
                   "images": len(self._images),
                   "complete": self.complete}
        out.update(IMPACT_METRICS.snapshot())
        return out

    def rebuild(self, memo, db) -> dict:
        """Recover this replica's slice from the shared memo tier:
        walk ``scan_keys``, re-derive every current-generation
        entry's postings via :func:`entry_postings`, reload persisted
        image records. An incomplete key scan (tier outage mid-walk)
        degrades to a partial index flagged ``complete=False`` —
        queries answer partially, mirroring Federator semantics."""
        t0 = time.perf_counter()
        keys, complete = memo.store.scan_keys("")
        ctx = memo.ctx_for(db)
        with self._lock:
            self._entries.clear()
            self._post.clear()
            self._cves.clear()
            self._images.clear()
            self._by_blob.clear()
        n_entries = n_images = 0
        for key in keys:
            if is_impact_key(key):
                raw = memo.store.get(key)
                rec = decode_image_record(raw) \
                    if raw is not None else None
                if rec is None:
                    continue
                self.observe_image(rec["image"], rec["blobs"],
                                   tenant=rec.get("tenant", ""),
                                   persist=False)
                n_images += 1
                continue
            entry = memo._load(key)
            if entry is None or entry.get("ctx") != ctx:
                continue
            self.set_entry(key, entry.get("blob", ""),
                           entry_postings(entry, db))
            n_entries += 1
        with self._lock:
            self.complete = complete
        IMPACT_METRICS.inc("rebuilds")
        IMPACT_METRICS.inc("rebuild_entries", n_entries)
        if not complete:
            IMPACT_METRICS.inc("rebuild_degraded")
        wall = time.perf_counter() - t0
        log.info("impact rebuild%s: %d entries, %d image records "
                 "in %.3fs (complete=%s)",
                 f" [{self.name}]" if self.name else "",
                 n_entries, n_images, wall, complete)
        return {"entries": n_entries, "images": n_images,
                "complete": complete, "wall_s": round(wall, 4)}


def brute_force_invert(memo, db, owns=None) -> dict:
    """Ground truth for the property test: a FRESH index rebuilt
    from the store, same ownership filter — the incremental index
    must match this snapshot byte-for-byte."""
    idx = ImpactIndex(owns=owns)
    idx.rebuild(memo, db)
    return idx.postings_snapshot()
