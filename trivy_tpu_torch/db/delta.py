"""Advisory delta between two compiled DB generations (copied from
``trivy_tpu/db/delta.py``).

``db update`` swaps a freshly compiled table set in
(``SwappableStore.swap``); the delta names exactly the ``(bucket,
package)`` join keys whose advisory content changed — added, removed,
or edited rows — so the findings memo (``memo/``) can re-match ONLY
the packages those keys touch against the new resident tables and
migrate everything else untouched, instead of flushing the store and
re-scanning the world.

Signatures are content-based (``memo.keys.adv_sig`` over the
advisory's encoded record) — row ids are compile-order artifacts and
shift wholesale whenever any bucket grows, so they can never anchor a
cross-generation comparison.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AdvisoryDelta:
    """Touched join keys between two generations."""

    touched: set = field(default_factory=set)   # {(bucket, pkg)}
    added: int = 0
    removed: int = 0
    changed: int = 0
    pairs_old: int = 0
    pairs_new: int = 0
    # pkg name -> set of touched buckets, for ecosystem-prefix joins
    # (library packages query "pip::" across every pip bucket)
    _by_name: dict = field(default_factory=dict)

    def note(self, bucket: str, pkg: str) -> None:
        self.touched.add((bucket, pkg))
        self._by_name.setdefault(pkg, set()).add(bucket)

    def touches(self, kind: str, bucket_or_prefix: str,
                name: str) -> bool:
        """Does this delta touch one memoized query? ``kind`` "os"
        queries name a concrete bucket; "lib" queries name an
        ecosystem prefix that spans every bucket under it."""
        if kind == "os":
            return (bucket_or_prefix, name) in self.touched
        buckets = self._by_name.get(name)
        if not buckets:
            return False
        return any(b.startswith(bucket_or_prefix) for b in buckets)

    def stats(self) -> dict:
        return {"touched_keys": len(self.touched),
                "added": self.added, "removed": self.removed,
                "changed": self.changed,
                "pairs_old": self.pairs_old,
                "pairs_new": self.pairs_new}


def _pair_sigs(cdb) -> dict:
    """{(bucket, pkg): [ordered advisory content sigs]} for one
    compiled DB — candidate_rows order, which is compile order."""
    from ..memo.keys import adv_sig
    out: dict = {}
    for bucket, pkgs in cdb.index.items():
        for pkg, rows in pkgs.items():
            out[(bucket, pkg)] = [adv_sig(cdb, r) for r in rows]
    return out


def advisory_delta(old_cdb, new_cdb) -> AdvisoryDelta:
    """Compare two compiled generations by advisory content."""
    old = _pair_sigs(old_cdb)
    new = _pair_sigs(new_cdb)
    delta = AdvisoryDelta(pairs_old=len(old), pairs_new=len(new))
    for key, sigs in old.items():
        nsigs = new.get(key)
        if nsigs is None:
            delta.removed += 1
            delta.note(*key)
        elif nsigs != sigs:
            delta.changed += 1
            delta.note(*key)
    for key in new:
        if key not in old:
            delta.added += 1
            delta.note(*key)
    return delta
