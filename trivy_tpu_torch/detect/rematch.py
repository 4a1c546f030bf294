"""Delta re-match job construction (copied from
``trivy_tpu/detect/rematch.py``).

When ``db update`` hot-swaps a new compiled generation in, the memo
(``memo/``) re-matches ONLY the packages the advisory delta
touched. Each memoized query record carries everything its job list
was built from — join identity, grammar, installed version, the
serialized package for driver gating — so the new generation's
candidate rows rebuild into :class:`ResidentPairJob` lists that are
bit-for-bit the jobs the next live scan would construct
(scan/local._vuln_jobs), and ONE dispatch against the new resident
tables refreshes every touched verdict.
"""

from __future__ import annotations

from typing import Optional

from .batch import ResidentPairJob


def build_rematch_jobs(cdb, sub: dict, tag: tuple) -> tuple:
    """One memoized query record → (jobs, advs_sig) against ``cdb``.

    ``sub`` is the entry sub-record the memo stored at scan time
    (memo/findings.py); ``tag`` rides each job's payload so the
    dispatch results map back to ``(entry index, query sig, local
    job index)``. Returns ``(None, "")`` when the record can no
    longer be evaluated (unknown driver family) — the caller drops
    the sub-record and the next live scan recomputes it."""
    grammar = sub.get("grammar") or "semver"
    installed = sub.get("installed", "")
    unfixed = bool(sub.get("unfixed", True))
    if sub.get("kind") == "os":
        rows = _os_rows(cdb, sub)
        if rows is None:
            return None, ""
    else:
        rows = cdb.candidate_rows_prefix(sub.get("bucket", ""),
                                         sub.get("name", ""))
    jobs = [ResidentPairJob(cdb=cdb, row=r, grammar=grammar,
                            pkg_version=installed,
                            report_unfixed=unfixed,
                            payload=(tag[0], tag[1], i))
            for i, r in enumerate(rows)]
    from ..memo.keys import advs_sig
    return jobs, advs_sig(jobs)


def _os_rows(cdb, sub: dict) -> Optional[list]:
    """Candidate rows for an OS-package record, gated EXACTLY the way
    the live scan gates them (driver.adv_match over the stored
    package)."""
    from ..memo.keys import pkg_from_record
    from .ospkg.drivers import DRIVERS

    driver = DRIVERS.get(sub.get("family", ""))
    if driver is None:
        return None
    pkg = pkg_from_record(sub.get("pkg"))
    os_name = sub.get("os", "")
    out = []
    for r in cdb.candidate_rows(sub.get("bucket", ""),
                                sub.get("name", "")):
        if driver.adv_match(os_name, pkg, cdb.rows_meta[r][2]):
            out.append(r)
    return out
