"""Per-tenant cost attribution and goodput metering (reference:
``trivy_tpu/obs/cost.py``; docs/observability.md "Cost attribution &
goodput").

The scheduler books every request's RESOURCE VECTOR — device-seconds
split by kernel family (the DFA secret sieve vs. the interval match),
host-seconds by phase (analyze, finish), candidate bytes ingested —
against its tenant in the process-wide :data:`COST_LEDGER`, at the
dispatch-ring/executor seam where the wall actually passes. Shared
batch wall is attributed across the batch's requests in proportion to
each request's work volume (candidate bytes + interval jobs), so the
books BALANCE by construction: the per-tenant attributed
device-seconds sum to the scheduler's measured per-dispatch
device-time integral (:func:`balance`).

The ledger keeps two books under one lock:

* **cumulative** — per-tenant totals since process start (the
  invoice);
* **windowed** — the same vectors in 10 s buckets: budgets read
  recent spend from them.

Tenant names are label values, so the books hold at most
``max_tenants`` distinct rows; overflow folds into ``other``.

Budgets (``--tenant-budget``) close the loop at admission: a tenant
whose windowed device-second spend exceeds its budget is throttled
(the 429 + Retry-After machinery of ``sched/tenant.py``) or
deprioritized (its requests drop to the budget's priority floor
inside its own WFQ lane) — the grammar mirrors ``--tenant-config``
(:func:`parse_budget_config`).

``export_state`` is the age-keyed export that the scan server's
``GET /costs`` carries; :func:`merge_cost_exports` sums N replicas'
exports and :func:`federated_costs` is the fleet rollup over their
``/costs`` (partial answers with a ``complete`` flag, never an
error).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass


# windowed-book resolution and retention: 10 s buckets, 1 h deep —
# enough for any budget window a --tenant-budget can declare
_BUCKET_S = 10.0
_RING_CAP = 360

# the label-cardinality rule: at most this many distinct tenant
# rows per book; overflow folds into "other"
MAX_COST_TENANTS = 64

# the resource vector every charge books (fixed key domain — the
# prom exposition renders one bounded family per key)
VECTOR_KEYS = (
    "device_interval_s",    # interval bucket-ladder kernel wall
    "device_dfa_s",         # DFA secret-sieve kernel wall
    "host_analyze_s",       # analyze phase (apply_layers + join)
    "host_finish_s",        # finish phase (decode + assemble)
    "bytes_in",             # candidate bytes ingested
    "memo_hits",            # verdicts served without device work
    "memo_misses",          # verdicts that paid for a dispatch
    "requests",             # completed requests
)

_BUDGET_ACTIONS = ("throttle", "deprioritize")


def _zero_vec() -> dict:
    return dict.fromkeys(VECTOR_KEYS, 0.0)


def device_seconds(vec: dict) -> float:
    """Total attributed device wall in one resource vector."""
    return float(vec.get("device_interval_s", 0.0)) \
        + float(vec.get("device_dfa_s", 0.0))


@dataclass(frozen=True)
class TenantBudget:
    """One tenant's device-second allowance over a sliding window
    (``--tenant-budget``). ``action`` picks the over-budget lever:
    ``throttle`` answers 429 + Retry-After on the existing quota
    machinery; ``deprioritize`` admits the request but clamps its
    priority to ``floor`` so it yields inside its own tenant lane."""

    tenant: str
    device_s: float              # windowed device-second allowance
    window_s: float = 60.0       # sliding window the spend is read over
    action: str = "throttle"     # throttle | deprioritize
    floor: int = -100            # priority floor for deprioritize

    def __post_init__(self):
        if self.device_s <= 0:
            raise ValueError(
                f"budget for {self.tenant!r}: device_s must be > 0")
        if self.window_s <= 0:
            raise ValueError(
                f"budget for {self.tenant!r}: window_s must be > 0")
        if self.action not in _BUDGET_ACTIONS:
            raise ValueError(
                f"budget for {self.tenant!r}: unknown action "
                f"{self.action!r} (choose from {_BUDGET_ACTIONS})")


_BUDGET_FIELDS = ("device_s", "window_s", "action", "floor")


def _coerce_budget_kv(key: str, raw: str):
    raw = str(raw).strip()
    if key == "action":
        return raw
    try:
        return int(raw) if key == "floor" else float(raw)
    except ValueError:
        raise ValueError(
            f"budget key {key!r}: bad value {raw!r}")


def parse_budget_config(text) -> dict:
    """``--tenant-budget`` parser → ``{tenant: TenantBudget}``.
    Accepts either a JSON file path (``{"alice": {"device_s": 2.5,
    "window_s": 60, "action": "throttle"}}``) or an inline spec
    mirroring ``--tenant-config``::

        alice:device_s=2.5,window_s=60,action=throttle;bob:device_s=1

    Unknown keys and malformed values raise ValueError so a typo'd
    budget fails the run up front instead of silently metering
    nothing."""
    if isinstance(text, dict) and all(
            isinstance(v, TenantBudget) for v in text.values()):
        return dict(text)
    text = (text or "").strip() if isinstance(text, str) else ""
    if not text:
        return {}
    if os.path.isfile(text):
        with open(text, "r", encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except ValueError as e:
                raise ValueError(
                    f"tenant budget {text!r}: invalid JSON ({e})")
        if not isinstance(doc, dict):
            raise ValueError(
                f"tenant budget {text!r}: want an object mapping "
                f"tenant -> settings")
        out: dict = {}
        for name, kv in doc.items():
            if not isinstance(kv, dict):
                raise ValueError(
                    f"budget {name!r}: want an object of settings")
            bad = set(kv) - set(_BUDGET_FIELDS)
            if bad:
                raise ValueError(
                    f"budget {name!r}: unknown keys {sorted(bad)} "
                    f"(choose from {sorted(_BUDGET_FIELDS)})")
            out[name] = TenantBudget(tenant=name, **{
                k: _coerce_budget_kv(k, str(v))
                for k, v in kv.items()})
        return out
    out = {}
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, sep, rest = chunk.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"bad tenant-budget entry {chunk!r} "
                f"(want name:device_s=...,window_s=...)")
        kv: dict = {}
        for pair in rest.split(","):
            pair = pair.strip()
            if not pair:
                continue
            key, eq, raw = pair.partition("=")
            key = key.strip()
            if not eq or key not in _BUDGET_FIELDS:
                raise ValueError(
                    f"bad tenant-budget entry {pair!r} for "
                    f"{name!r} (choose from "
                    f"{sorted(_BUDGET_FIELDS)})")
            kv[key] = _coerce_budget_kv(key, raw)
        if "device_s" not in kv:
            raise ValueError(
                f"tenant-budget entry {name!r}: device_s is "
                f"required")
        out[name] = TenantBudget(tenant=name, **kv)
    return out


class CostLedger:
    """Per-tenant resource-vector books; every method thread-safe.

    ``enabled=False`` turns every ``charge`` into an immediate
    return, so metering overhead can be measured as the throughput
    delta between the two settings."""

    def __init__(self, max_tenants: int = MAX_COST_TENANTS,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.max_tenants = max(1, int(max_tenants))
        self.enabled = True
        self._cum: dict = {}        # tenant -> vector
        self._ring: dict = {}       # bucket -> {tenant: vector}
        self.charges = 0            # charge() calls booked

    def reset(self) -> None:
        """Fresh books (tests isolate their runs with it)."""
        with self._lock:
            self._cum.clear()
            self._ring.clear()
            self.charges = 0

    def _slot(self, table: dict, tenant: str) -> dict:
        # top-K + other fold: past the cap every new
        # tenant shares one row; len() gate + "other" constant are
        # what the label-cardinality lint checks for
        if tenant not in table and len(table) >= self.max_tenants:
            tenant = "other"
        row = table.get(tenant)
        if row is None:
            row = table[tenant] = _zero_vec()
        return row

    def charge(self, tenant: str, **amounts) -> None:
        """Book one resource-vector increment against ``tenant``.
        Unknown vector keys raise (a typo'd charge site must fail
        tests, not silently leak spend)."""
        if not self.enabled:
            return
        bad = set(amounts) - set(VECTOR_KEYS)
        if bad:
            raise ValueError(
                f"unknown cost vector keys {sorted(bad)} "
                f"(choose from {VECTOR_KEYS})")
        tenant = str(tenant or "anon")[:64]
        bucket = int(self._clock() / _BUCKET_S)
        with self._lock:
            self.charges += 1
            win = self._ring.get(bucket)
            if win is None:
                win = self._ring[bucket] = {}
                # bound the windowed book: drop buckets past the
                # retention horizon (dict insertion order is bucket
                # order on a monotonic clock)
                while len(self._ring) > _RING_CAP:
                    oldest = next(iter(self._ring))
                    if oldest == bucket:
                        break
                    del self._ring[oldest]
            for row in (self._slot(self._cum, tenant),
                        self._slot(win, tenant)):
                for k, v in amounts.items():
                    row[k] += float(v)

    # --- reads ---

    def window_device_s(self, tenant: str,
                        window_s: float) -> float:
        """Device-seconds ``tenant`` spent over the trailing
        ``window_s`` (budget admission reads this)."""
        now_bucket = int(self._clock() / _BUCKET_S)
        span = max(1, int(window_s / _BUCKET_S))
        total = 0.0
        with self._lock:
            for b in range(now_bucket - span + 1, now_bucket + 1):
                row = self._ring.get(b, {}).get(tenant)
                if row is not None:
                    total += device_seconds(row)
        return total

    def totals(self) -> dict:
        """Cumulative fleet-wide vector (all tenants summed)."""
        out = _zero_vec()
        with self._lock:
            for vec in self._cum.values():
                for k in VECTOR_KEYS:
                    out[k] += vec[k]
        return out

    def snapshot(self, aot_compile_s: float = 0.0) -> dict:
        """The ``/costs`` (and ``/metrics`` section) payload:
        per-tenant cumulative vectors plus the amortized compile bill
        — ``aot_compile_s`` (the process's total compile wall) split
        across tenants by device-second share, so warming costs land
        on whoever used the warmth (in the port: the boot's kernel
        build and warm launches, ``runtime/aot.py``)."""
        with self._lock:
            tenants = {t: dict(vec)
                       for t, vec in sorted(self._cum.items())}
            charges = self.charges
        total_dev = sum(device_seconds(v) for v in tenants.values())
        totals = _zero_vec()
        for t, vec in tenants.items():
            share = device_seconds(vec) / total_dev \
                if total_dev > 0 else 0.0
            vec["aot_amortized_s"] = round(
                float(aot_compile_s) * share, 6)
            for k in VECTOR_KEYS:
                totals[k] += vec[k]
                vec[k] = round(vec[k], 6)
        for k in VECTOR_KEYS:
            totals[k] = round(totals[k], 6)
        totals["aot_amortized_s"] = round(float(aot_compile_s)
                                          if tenants else 0.0, 6)
        return {"tenants": tenants, "totals": totals,
                "charges": charges,
                "device_s": round(total_dev, 6),
                "enabled": self.enabled}


    def export_state(self) -> dict:
        """Federation export: cumulative vectors plus AGE-keyed
        windowed buckets (age 0 = the current 10 s bucket) — the
        same monotonic-only coordinate as
        :meth:`obs.slo.SloEngine.export_state`, so a federating
        front can merge replicas without any shared epoch."""
        now_bucket = int(self._clock() / _BUCKET_S)
        with self._lock:
            cum = {t: dict(vec) for t, vec in self._cum.items()}
            buckets = {}
            for b, table in self._ring.items():
                age = now_bucket - b
                if 0 <= age < _RING_CAP:
                    buckets[str(age)] = {
                        t: dict(vec) for t, vec in table.items()}
        return {"schema": 1, "bucket_s": _BUCKET_S,
                "cum": cum, "buckets": buckets}


def merge_cost_exports(exports) -> dict:
    """Sum N replicas' :meth:`CostLedger.export_state` payloads by
    (tenant) and (age, tenant) — same-age buckets across replicas
    cover the same trailing wall interval, so addition is the whole
    merge. Tenant rows past the cap fold into ``other`` (the
    cardinality rule holds fleet-wide, not just per replica). Malformed entries
    are dropped, never fatal."""
    cum: dict = {}
    buckets: dict = {}

    def fold(table: dict, tenant: str) -> dict:
        # top-K + other: the fleet-wide merge honors the same
        # cardinality cap as each replica's own books
        if tenant not in table and \
                len(table) >= MAX_COST_TENANTS:
            tenant = "other"
        return table.setdefault(tenant, _zero_vec())

    def add(table: dict, tenant, vec) -> None:
        if not isinstance(tenant, str) or not isinstance(vec, dict):
            return
        row = fold(table, tenant[:64])
        for k in VECTOR_KEYS:
            try:
                row[k] += float(vec.get(k, 0.0))
            except (TypeError, ValueError):
                continue
        return

    for exp in exports:
        if not isinstance(exp, dict):
            continue
        for tenant, vec in (exp.get("cum") or {}).items():
            add(cum, tenant, vec)
        for age, table in (exp.get("buckets") or {}).items():
            if not isinstance(table, dict):
                continue
            try:
                age_key = str(int(age))
            except (TypeError, ValueError):
                continue
            dst = buckets.setdefault(age_key, {})
            for tenant, vec in table.items():
                add(dst, tenant, vec)
    return {"schema": 1, "bucket_s": _BUCKET_S,
            "cum": cum, "buckets": buckets}


def balance(attributed_s: float, measured_s: float,
            tolerance: float = 0.02) -> dict:
    """The accounting identity as a verdict: attributed per-tenant
    device-seconds must reconcile with the measured per-dispatch
    device-time integral within ``tolerance``. Tiny books (< 1 ms
    both sides) are vacuously balanced — there is nothing to
    misattribute."""
    attributed_s = float(attributed_s)
    measured_s = float(measured_s)
    if measured_s < 1e-3 and attributed_s < 1e-3:
        return {"balanced": True, "attributed_s": attributed_s,
                "measured_s": measured_s, "skew": 0.0,
                "tolerance": tolerance}
    base = max(measured_s, 1e-9)
    skew = abs(attributed_s - measured_s) / base
    return {"balanced": skew <= tolerance,
            "attributed_s": round(attributed_s, 6),
            "measured_s": round(measured_s, 6),
            "skew": round(skew, 6), "tolerance": tolerance}


# the process-wide books every scheduler/scanner charges into
# (mirroring RING_METRICS, MEMO_METRICS et al.)
COST_LEDGER = CostLedger()


def fetch_costs(url: str, token: str = "",
                token_header: str = "Trivy-Token",
                timeout_s: float = 2.0) -> dict:
    """One replica's ``GET /costs`` — raises on transport/decode
    failure (the fan-out absorbs it into a down row)."""
    import urllib.request
    req = urllib.request.Request(url.rstrip("/") + "/costs")
    if token:
        req.add_header(token_header, token)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    if not isinstance(doc, dict):
        raise ValueError("costs answer is not a JSON object")
    return doc


def federated_costs(replicas, token: str = "",
                    token_header: str = "Trivy-Token",
                    timeout_s: float = 2.0, fan_in: int = 8,
                    fetch=None) -> dict:
    """Fleet cost rollup over ``[(name, url), ...]`` — Federator
    semantics (obs/federate.py): bounded fan-in, per-peer timeout, partial
    answers with a ``complete`` flag, never an error. ``fetch(url)
    -> dict`` is injectable so unit tests exercise the merge
    without sockets."""
    fetch = fetch or (lambda u: fetch_costs(
        u, token=token, token_header=token_header,
        timeout_s=timeout_s))
    replicas = list(replicas)
    rows: list = [None] * len(replicas)
    sem = threading.Semaphore(max(1, int(fan_in)))

    def work(i: int, name: str, url: str) -> None:
        with sem:
            try:
                doc = fetch(url)
            except Exception as e:  # noqa: BLE001 — a down peer is
                # the condition federation exists to absorb: mark
                # it, answer partially
                rows[i] = {"replica": name, "up": False,
                           "complete": False, "error": repr(e)}
                return
            rows[i] = {"replica": name, "up": True,
                       "complete": bool(doc.get("complete", True)),
                       "error": "", "answer": doc}

    threads = [threading.Thread(target=work, args=(i, n, u),
                                daemon=True)
               for i, (n, u) in enumerate(replicas)]
    for t in threads:
        t.start()
    for t in threads:
        # second-layer backstop over the per-fetch timeout, so a
        # wedged socket cannot wedge the rollup
        t.join(timeout_s * 2 + 1.0)
    for i, (name, _url) in enumerate(replicas):
        if rows[i] is None:
            rows[i] = {"replica": name, "up": False,
                       "complete": False, "error": "query timeout"}

    exports = []
    measured_s = 0.0
    for row in rows:
        answer = row.get("answer")
        if not answer:
            continue
        if isinstance(answer.get("export"), dict):
            exports.append(answer["export"])
        try:
            measured_s += float(answer.get("measured_device_s", 0.0))
        except (TypeError, ValueError):
            pass
    merged = merge_cost_exports(exports)
    tenants = {}
    for t, vec in sorted(merged["cum"].items()):
        tenants[t] = {k: round(v, 6) for k, v in vec.items()}
        tenants[t]["device_s"] = round(device_seconds(vec), 6)
    attributed_s = sum(device_seconds(v)
                       for v in merged["cum"].values())
    complete = all(r["up"] and r["complete"] for r in rows) \
        if rows else True
    return {
        "tenants": tenants,
        "attributed_device_s": round(attributed_s, 6),
        "measured_device_s": round(measured_s, 6),
        "balance": balance(attributed_s, measured_s),
        "complete": complete,
        "replicas": [{k: r[k] for k in
                      ("replica", "up", "complete", "error")}
                     for r in rows],
    }


# the process-wide books every scheduler/scanner charges into
# (mirroring RING_METRICS, MEMO_METRICS et al.)
COST_LEDGER = CostLedger()
